"""Training phases and artifact dumps — port of tgtc/train (Phases A, B, C3 and F so far)."""
