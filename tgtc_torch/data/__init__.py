"""Scene loading, ray generation and camera paths — port of tgtc/data."""
