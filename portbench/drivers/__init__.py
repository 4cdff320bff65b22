"""Traffic drivers: each traffic file names one, with its parameters."""
