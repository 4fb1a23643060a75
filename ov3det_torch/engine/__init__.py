"""Entry points of the port: the eval step, the detector and the training step."""
