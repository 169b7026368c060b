"""The plain reference and the comparisons that decide `correct`."""
