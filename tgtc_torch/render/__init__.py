"""Rendering — port of tgtc/render (eager and fused NeRF renders)."""
