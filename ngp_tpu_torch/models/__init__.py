"""Network heads and the occupancy grid."""
