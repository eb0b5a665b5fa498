"""3DGAN generator and physics validation of the port."""
