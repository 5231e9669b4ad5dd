"""Model configurations and input shapes the port runs (the port of
``repro/configs``: the LM, GNN and recsys families)."""
