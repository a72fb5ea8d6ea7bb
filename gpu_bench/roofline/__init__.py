"""The frozen work counts and the table of peaks that roofline shares are
read against."""
