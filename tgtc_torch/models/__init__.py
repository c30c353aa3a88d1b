"""Model definitions — port of tgtc/models (the NeRF trunk, the style field, the
2D StyTr² network, the VAE and the AdaIN network)."""
