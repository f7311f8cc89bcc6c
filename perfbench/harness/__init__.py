"""The harness: set-up, window, traces and counts of the port's cells."""
