"""The plain reference that decides `correct`: numpy and PyTorch only, no
module of the program. `frozen/` is a frozen copy of the host plan code."""
