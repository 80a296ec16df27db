"""The plain reference: float64 PyTorch and numpy that imports nothing of the program."""
