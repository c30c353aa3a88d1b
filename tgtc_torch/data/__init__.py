"""Scene loading and ray generation — port of tgtc/data."""
