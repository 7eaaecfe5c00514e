"""The plain float32 reference the correctness check compares with."""
