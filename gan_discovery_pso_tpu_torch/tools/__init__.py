"""Drivers over the port's command line: `run_experiment` runs the
reference experiment chain on the card, one stage per subprocess."""
