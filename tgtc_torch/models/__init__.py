"""Model definitions — port of tgtc/models (the NeRF trunk, the style field and the
2D StyTr² network so far)."""
