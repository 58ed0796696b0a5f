"""The load generators that traffic files name by their `kind`."""
