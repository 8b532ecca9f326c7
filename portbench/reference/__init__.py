"""The plain PyTorch reference of each configuration family and of the rule."""
