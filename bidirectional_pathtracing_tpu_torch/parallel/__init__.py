"""A frame over a (dp, sp) grid of ranks: torch.distributed processes."""
