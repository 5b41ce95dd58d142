"""Host-side utilities of the port (pipeline telemetry)."""
