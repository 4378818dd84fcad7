"""Command-line tools of the port: building a .scorer package."""
