"""The plain reference the benchmark holds the program's outputs to.  It
imports nothing of the program."""
