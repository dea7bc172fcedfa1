"""The plain reference of the benchmark: numpy only, nothing of the program."""
