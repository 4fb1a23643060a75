"""Entry points of the port: the eval step and the detector."""
