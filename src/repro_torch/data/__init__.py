"""Data: the synthetic NEMSIS-schema EMS datasets (numpy)."""
