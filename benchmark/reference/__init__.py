"""The plain reference: Python integers, constants frozen as data."""
