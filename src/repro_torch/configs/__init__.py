"""Model configurations of the port (the paper's TM zoo)."""
