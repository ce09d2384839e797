"""Command-line tools of the port (``python -m purejaxql_torch.scripts.<tool>``)."""
