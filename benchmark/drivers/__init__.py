"""One module for each way of driving the program, named by a traffic
mix's ``driver``; each has ``run(cell) -> harness.Outcome``."""
