"""Model definitions — port of tgtc/models (the NeRF trunk so far)."""
