"""The plain reference the benchmark holds the program to. It imports torch
and numpy only: nothing of the program, nothing of JAX."""
