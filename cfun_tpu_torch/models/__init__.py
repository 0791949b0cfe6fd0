"""The CFUN network of the port: trunk, heads and the inference graph."""
