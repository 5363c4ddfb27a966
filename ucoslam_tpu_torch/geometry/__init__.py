"""Camera model, SE(3) and trajectory alignment."""
