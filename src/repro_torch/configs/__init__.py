"""Model configurations and input shapes the port runs (the port of the
two-tower and gin-tu parts of ``repro/configs``)."""
