"""Math, samplers and the counter-based RNG (torch)."""
