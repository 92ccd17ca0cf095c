"""Launchers: GCN serving."""
