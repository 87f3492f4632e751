"""The plain references that decide `correct`.  They import nothing of the
program and take nothing that it made: the benchmark hands them the same
inputs it hands the program, and the program's outputs, to judge."""
