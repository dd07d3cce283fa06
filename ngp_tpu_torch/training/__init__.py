"""The eval half of the NeRF trainers."""
