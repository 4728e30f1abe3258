"""Model code of the port: layers, attention, the dense decoder."""
