"""The shared yardstick: the window, the profile pass, the draws and weights
handed to both sides, the comparison that decides `correct`, the last line."""
