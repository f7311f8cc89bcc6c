"""Plain PyTorch references that decide whether a run is correct; they import nothing of the program."""
