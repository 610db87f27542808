"""The harness: finds a cell's files by name, runs its driver, reads the
trace and prints the result line."""
