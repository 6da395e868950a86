"""Volume rendering."""
