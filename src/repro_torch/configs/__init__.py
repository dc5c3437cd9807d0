"""Model configurations the port runs."""
