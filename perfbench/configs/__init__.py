"""Family reference modules: perfbench/configs/<family>.py."""
