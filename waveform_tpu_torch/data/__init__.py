"""Plan tables measured on the card, shipped with the port (utils/plans.py)."""
