"""Launchers: the serving and training drivers, and the input stand-ins."""
