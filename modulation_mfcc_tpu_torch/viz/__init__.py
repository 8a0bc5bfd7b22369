"""Static (matplotlib) rendering of the reference's display capabilities."""
