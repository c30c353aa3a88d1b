"""Host-side utilities — port of tgtc/utils (the native IO shim so far)."""
