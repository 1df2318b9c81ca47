"""Weight loading and conversion helpers of the port."""
