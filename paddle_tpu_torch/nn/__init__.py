"""Neural-network pieces of the port."""
