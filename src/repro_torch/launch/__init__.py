"""Launchers: GCN and LM serving, LM training."""
