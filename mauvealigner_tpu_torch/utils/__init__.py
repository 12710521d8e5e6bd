"""Host-side utilities: simulation, option parsing, temp files, timing."""
