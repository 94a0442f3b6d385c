"""One module a way of driving the program's entry, found by a traffic
mix's `driver`: `setup` (the program, its inputs, its first units for the
comparison, the warm-up), `window`, `unit` (the profile pass's), `check`
(the comparison, once the program is freed) and MODE ('train' or 'serve',
the family's paths)."""
