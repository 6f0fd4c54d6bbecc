"""Drivers of the program, one a traffic mode: perfbench/modes/<mode>.py."""
