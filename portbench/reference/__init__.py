"""The plain reference that decides ``correct``: plain PyTorch, nothing of
the program (`glm`)."""
