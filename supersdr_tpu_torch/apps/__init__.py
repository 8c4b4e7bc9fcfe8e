"""Application assemblies on the port: the live KiwiSDR session."""
