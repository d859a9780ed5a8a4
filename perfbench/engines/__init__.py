"""Runners of the program's engines, one module per engine named in a
configuration's "engine": each builds the engine from the benchmark's
inputs, runs one round through the engine's own call, makes the periodic
best call, and exports states for the output check. These are the only
modules of the benchmark that import the program."""
