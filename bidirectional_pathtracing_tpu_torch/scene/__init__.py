"""Scene schema and procedural scenes (torch)."""
