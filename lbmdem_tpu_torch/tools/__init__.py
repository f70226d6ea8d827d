"""Command-line tools of the port (run on the card by default)."""
