"""Built-in AIRs."""
