"""The plain reference (see evaluate.py)."""
