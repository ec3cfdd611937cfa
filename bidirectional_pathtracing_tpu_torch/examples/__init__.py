"""Examples of the port: inverse rendering through the differentiable pass."""
