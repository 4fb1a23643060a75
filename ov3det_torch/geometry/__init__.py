"""Box geometry of the port (torch) and the host-side numpy codec."""
