"""EMSNet in PyTorch: parameters as plain dicts of tensors, laid out
exactly as the JAX package's pytrees (weights ``(d_in, d_out)``)."""
