"""The plain reference of LZ-ANI's all-vs-all (Python and numpy). It
imports nothing of the program under test."""
