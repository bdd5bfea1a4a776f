"""Eval and train steps of the port."""
