"""Plain references the benchmark judges the program's searches against.
They import nothing of the program."""
