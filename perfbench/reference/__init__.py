"""The plain reference the comparison holds the port against: plain PyTorch
in float32 with TF32 off. It imports nothing of the port."""
