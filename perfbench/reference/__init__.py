"""The benchmark's plain reference: NUTS, its targets and its random draws in
plain NumPy and PyTorch.  Nothing here imports the program under test."""
