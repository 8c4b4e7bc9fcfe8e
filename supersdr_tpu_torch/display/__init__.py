"""Headless rendering (copies of the reference's `display/` modules):
colormaps, waterfall/spectrum raster composition, stdlib PNG output."""
