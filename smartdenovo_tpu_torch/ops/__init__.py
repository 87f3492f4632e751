"""Device compute of the overlap stage, on torch tensors."""
