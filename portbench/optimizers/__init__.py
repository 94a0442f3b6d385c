"""One module an optimizer, found by the configuration's `optimizer.name`:
its arguments to the program's build_optimizer, the step-1 gradient read
back from the program's optimizer state, and its plain reference."""
