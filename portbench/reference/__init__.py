"""The plain reference: plain PyTorch and NumPy, nothing of the program."""
