"""The plain reference the benchmark holds the port's fleets against:
the protocol tables, the N-remote engine and its closed-loop driver, and
the traffic generators, in NumPy and plain PyTorch.  It imports nothing
of the program."""
