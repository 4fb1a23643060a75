"""Host-side run utilities of the port: meters and the scalar logger."""
