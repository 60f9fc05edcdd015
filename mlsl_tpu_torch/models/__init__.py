"""Models and the data-parallel trainer."""
