"""The plain reference: the benchmark's own inputs (assets.py) and the
frame they make (raster.py). Imports nothing of the measured program."""
