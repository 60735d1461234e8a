"""Reporting of the port: solution and error plots, the paper's LaTeX
tables and its publication figures. matplotlib is imported only by the
function that draws; where it is not installed, the figure is skipped
with one printed line."""
