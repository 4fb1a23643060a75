"""The set-prediction criterion of the port."""
