"""The benchmark's plain reference: encoders, exact search and IR metrics
in plain PyTorch and Python.  It imports nothing of the program, so it
judges what the program computes and never computes with it."""
