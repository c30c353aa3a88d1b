"""Training phases and artifact dumps — port of tgtc/train (Phase B so far)."""
