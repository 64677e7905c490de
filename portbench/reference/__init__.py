"""The plain reference the cells are judged against (plain PyTorch and
numpy; nothing of the program)."""
