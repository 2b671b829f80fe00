"""Device selection, test comparators and card timing."""
