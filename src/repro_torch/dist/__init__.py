"""Distribution utilities: sharding rule tables, gradient compression and
the data-parallel collectives of the train step."""
