"""The paper's applications on the port: the Table-III networks as graphs
(``paper_graphs``), the camera ISP of §V (``camera``) and the simulated
serving scenario (``serving``)."""
