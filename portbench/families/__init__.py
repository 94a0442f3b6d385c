"""How the benchmark drives the program, one module a model family: builds
its model, optimizer and entries from the configuration file."""
