"""Protocol-level types shared by the port's engines."""
