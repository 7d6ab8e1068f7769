"""Plain NumPy / SciPy references of the cells' answers, computed from the
benchmark's own edge arrays. They import nothing of the program."""
