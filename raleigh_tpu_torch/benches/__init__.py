"""The port's A/B sweeps and their timer."""
