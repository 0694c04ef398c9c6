"""The yardstick's arithmetic: model FLOPs, kernel bytes, the card's peaks."""
