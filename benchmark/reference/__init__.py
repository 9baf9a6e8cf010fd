"""Plain references the benchmark judges the program's outputs against.

Nothing here imports the program under test."""
