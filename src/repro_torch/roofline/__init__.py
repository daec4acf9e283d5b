"""Roofline terms of a step (port of ``repro.roofline``): the H100's
figures and the counts of one step's operations."""
