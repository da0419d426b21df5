"""The plain reference the benchmark holds the port to (see lio/ and lanes.py)."""
