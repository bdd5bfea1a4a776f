"""Command-line entry points of the port: ``train``, ``test``, ``params``."""
