"""Host-side visualisation of the port's runs."""
