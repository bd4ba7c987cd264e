"""CPU tests of the benchmark (`python -m pytest benchmark/tests -q`);
those marked `cuda` run on the card."""
